"""Device-idle ms of the traced window inside the program's fr.optimizer span (Adam's step and the schedule's), per training step (fr.backward span)."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.optimizer', 'idle_ms', per='fr.backward')
