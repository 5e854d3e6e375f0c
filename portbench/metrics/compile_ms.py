"""Host ms per job of building and compiling its circuit (the harness's
``compile`` span around the builder and ``compile()``), summed over the
window and divided by the window's jobs; None where no job compiles."""


def read(ctx):
    spans = [j.spans["compile"] for j in ctx.jobs if "compile" in j.spans]
    return sum(spans) * 1e3 / len(ctx.jobs) if spans else None
