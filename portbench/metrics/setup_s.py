"""Process start to the window's start: imports, CUDA, the seeded field,
its derived tables, the cell's warm-up."""


def read(ctx):
    return ctx["setup_s"]
