"""Every token the stack generated in the window over the window's host
seconds; the count is the program's ``ServeMetrics.tokens_generated``,
which the harness checks against the tokens the engine calls returned."""


def read(run):
    return run.metrics.tokens_generated / run.window_s
