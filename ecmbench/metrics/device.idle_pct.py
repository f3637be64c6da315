"""device.idle_pct: the share of the window in which no kernel ran on a
card, in percent: 1 - (union of the card's kernel intervals in the trace)
/ window, the mean over the cards."""


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
