"""Seconds from the process's start to the first timed call: imports,
the card's context, the inputs, the program's set-up and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
