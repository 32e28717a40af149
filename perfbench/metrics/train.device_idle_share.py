"""Share of the measured (untraced) training window in which no kernel or
copy ran on the card, in %: 1 less the device's busy time an update
(the union of the device intervals of the traced window over its
updates) times the measured window's updates over its length. The
profiler slows the host's launches, not the device's work, so the
traced window's own idle share reads higher than the system's."""


def read(ctx):
    trace, traced, rec = ctx.trace, ctx.traced, ctx.record
    if ctx.kind != "train" or trace is None or traced is None \
            or not traced.updates or not rec.updates or ctx.window_s <= 0:
        return None
    busy = trace.busy_s()
    if busy <= 0:               # nothing ran on a device
        return None
    busy_per_update = busy / traced.updates
    return 100.0 * (1.0 - busy_per_update * rec.updates / ctx.window_s)
