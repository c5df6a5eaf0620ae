"""What decides `correct`: the window's answers against the reference.

A sample of the searches asked in the window, drawn from the seed, is
worked out again by the configuration's reference: one search of each
slot the window's searches were admitted to (or, where the program does
not show its slots, of each uid modulo the slot count), the search with
the most supersteps, and more drawn at random up to the cell's
"check_searches".  Every move they committed must be the reference's
move with the reference's root visit counts (`moves_mismatched`, limit
0).  Every move asked in the window must have come, late or not
(`moves_never_committed`, limit 0).  A configuration adds numbers of its
own (its system's `extra_checks`), each with its limit in the
configuration's "limits".
"""

from __future__ import annotations

import numpy as np


def sample(loop, n: int, seed: int, slots: int) -> list:
    """Searches with a move asked in the window and one committed, drawn
    from the seed: one a slot (the uid modulo `slots` for a search whose
    slot was not seen), the one with the most supersteps, and at random
    up to n in all."""
    pool = [s for s in loop.searches if s.moves
            and any(loop.t0 <= t < loop.t1 for t in s.asks)]
    if not pool:
        return []
    rng = np.random.default_rng([int(seed), 0xC4EC])
    by_slot: dict = {}
    for i, s in enumerate(pool):
        key = s.slot if s.slot is not None else \
            ("uid", s.spec["uid"] % slots)
        by_slot.setdefault(key, []).append(i)
    pick = {int(rng.choice(ids)) for _, ids in sorted(by_slot.items(),
                                                      key=lambda kv: str(kv[0]))}
    pick.add(max(range(len(pool)), key=lambda i: (
        pool[i].spec["budget"] * len(pool[i].moves), -i)))
    rest = [i for i in range(len(pool)) if i not in pick]
    more = max(0, min(n - len(pick), len(rest)))
    pick.update(int(i) for i in rng.choice(rest, more, replace=False))
    return [pool[i] for i in sorted(pick)]


def slots_covered(picked: list) -> int:
    return len({s.slot for s in picked if s.slot is not None})


def mismatched(system, searches: list) -> tuple:
    """(moves whose action or visit counts differ from the reference's,
    moves compared)."""
    bad = total = 0
    for s in searches:
        ref = system.reference_moves(s.spec, len(s.moves))
        for i, (action, visits) in enumerate(s.moves):
            total += 1
            if (i >= len(ref) or ref[i][0] != action
                    or not np.array_equal(ref[i][1], visits)):
                bad += 1
    return bad, total


def compare(system, loop, config: dict, n: int, seed: int,
            info: dict = None) -> dict:
    """{name: {"value", "limit"}} of every number compared; a value must
    not exceed its limit, and at least one move must have been compared
    (`moves_compared`, least 1).  A configuration's limit is a number (the
    most a value may be) or {"least": n}.  `info`, where given, gets the
    sample's size and the slots it covers, and what the system reports
    besides (its `replay_info`, where it has one)."""
    never = sum(1 for s, i in loop.asked() if i >= len(s.commits))
    picked = sample(loop, n, seed, config["server"]["G"])
    bad, total = mismatched(system, picked)
    if info is not None:
        info.update(searches_checked=len(picked),
                    slots_checked=slots_covered(picked))
        if hasattr(system, "replay_info"):
            info["replay_f64"] = system.replay_info(picked)
    values = {"moves_mismatched": bad, "moves_never_committed": never}
    values.update(system.extra_checks())
    values["moves_compared"] = total
    limits = dict(config["limits"], moves_compared={"least": 1})
    return {k: dict(limits[k], value=v) if isinstance(limits[k], dict)
            else {"value": v, "limit": limits[k]}
            for k, v in values.items() if k in limits}


def passed(checks: dict) -> bool:
    for c in checks.values():
        if "least" in c:
            if not c["value"] >= c["least"]:
                return False
        elif c["limit"] is None or not c["value"] <= c["limit"]:
            return False
    return True


def lines(checks: dict) -> list:
    out = []
    for k, c in checks.items():
        rule = f">= {c['least']}" if "least" in c else f"<= {c['limit']}"
        out.append(f"check {k} = {c['value']!r} (limit {rule})")
    return out
