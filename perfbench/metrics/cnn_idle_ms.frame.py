"""Device-idle ms of the traced window inside the program's fr.cnn span (the regressor's forward), per request."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.cnn', 'idle_ms', per=None)
