"""setup_program_s: the part of setup_s that the program's own set-up takes:
the summed seconds of the top-level setup spans the run's process recorded
(`matryodshka_tpu_torch.trace.setup_spans()`: `_build.lib` with
`_build.build` when it compiles, `entry.make_params` or
`test.build_hres_render_fn`), on the clock of setup_s."""

from msi_bench import program_spans


def read(ctx):
    from matryodshka_tpu_torch import trace

    spans = getattr(trace, "setup_spans", None)
    return None if spans is None else program_spans.top_level_s(spans())
