"""Share of the outer systems factored in the traced window that no
caller asked for: 1 - points asked / systems factored, the latter from
the port's ``PTAMetrics`` counter ``hd_outer_solves``."""


def read(ctx):
    solved = ctx["counters"].get("hd_outer_solves", 0)
    if not solved:
        return None
    return 1.0 - ctx["points"] / solved
