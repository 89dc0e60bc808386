"""Share (%) of the traced slice in which no operation ran on the device:
one minus the union of the kernels', copies' and sets' intervals over the
slice's length."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
