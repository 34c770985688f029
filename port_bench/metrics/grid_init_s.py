"""Host set-up of the grid and the initial state: the program's own
``init_grid`` and ``init_state`` phase timers (``core/grid.py``,
``model/init.py``)."""


def read(ctx):
    t = ctx["timers"]
    if "init_grid" not in t or "init_state" not in t:
        return None
    return t["init_grid"] + t["init_state"]
