"""Right-hand sides solved to the configuration's rtol over the whole
window: columns completed over the window's seconds."""


def read(run):
    return run.columns * run.requests / run.window_s if run.window_s > 0 else None
