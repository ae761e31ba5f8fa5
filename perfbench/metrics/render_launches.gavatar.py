"""Host launch calls inside the program's fr.render spans (the whole render_coeffs call on the avatar's frames), per microbatch: a count."""

from perfbench import spans


def read(ctx):
    return spans.reading(ctx, 'fr.render', 'launches', per='fr.render')
