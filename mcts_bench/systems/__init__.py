"""The kinds of system a configuration names ("system"): one module
each, with a `System(config, seed, device, trace)` that holds the
program's client and answers for the reference."""


def make_client(config: dict, env, sim, device, trace: bool):
    """The port's serving entry point as the configuration states it;
    with `trace`, the program's own tracer (which also fences its phase
    timers) and metrics registry are on."""
    from repro_torch.core import TreeConfig
    from repro_torch.obs.trace import Tracer
    from repro_torch.service import SearchClient

    server = dict(config["server"])
    return SearchClient(
        env, sim, default_cfg=TreeConfig(**config["tree"]),
        device=device, trace=Tracer(capacity=1 << 18) if trace else False,
        metrics=trace, **server)
