"""Kernel launches a unit of work over the window, from the program's
launch counters (every kernel wrapper's ``launches``); a reselection by the
guard shows as more than one."""


def read(r):
    return r["launches"] / r["launches_units"] if r["launches_units"] else None
