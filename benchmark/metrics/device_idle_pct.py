"""device_idle_pct.<mix>: the share of the traced window in which no kernel,
copy or fill ran on the device (the union of the profiler's device intervals
against the window's length), in percent."""


def read(obs, name):
    if obs.trace is None or obs.trace.window_s <= 0 \
            or not obs.trace.device_ops:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s() / obs.trace.window_s)
