"""Device ms of the kernels launched inside the program's fr.backward span, on any thread, after its fr.coeff_grad mark (the CNN's backward), per step."""

from perfbench import spans


def read(ctx):
    return spans.split_ms(ctx, 'fr.backward', 'fr.coeff_grad', 'after',
                          per='fr.backward')
