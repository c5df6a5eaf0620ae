"""The policy-value net's operations a row, from its shapes (6x6 board,
C channels): two 3x3 convolutions (2 -> C, C -> C), a 1x1 policy
convolution (C -> 2) and a 72 x 36 matrix, a value head C*36 x 64 and
64 x 1.  Two FLOPs a multiply-add; ReLU, tanh and the softmax are left
out (they are not multiply-adds and are under 0.1% of the count)."""

CELLS = 36


def flops_per_row(C: int) -> int:
    macs = (CELLS * C * 2 * 9          # conv 3x3, 2 -> C
            + CELLS * C * C * 9        # conv 3x3, C -> C
            + CELLS * 2 * C            # conv 1x1, C -> 2
            + 2 * CELLS * CELLS        # policy matrix 72 x 36
            + C * CELLS * 64           # value matrix C*36 x 64
            + 64)                      # value matrix 64 x 1
    return 2 * macs
