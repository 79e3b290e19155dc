"""Search simulations completed per second over all boards: lockstep
moves x boards x rollouts a move, over the window (host clock)."""


def read(ctx):
    if "rollouts" not in ctx.work:
        return None
    return ctx.work["rollouts"] / ctx.window_s
