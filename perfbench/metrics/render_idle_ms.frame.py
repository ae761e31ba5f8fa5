"""Device-idle ms of the traced window inside the program's fr.render span (render_coeffs), per request."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.render', 'idle_ms', per=None)
