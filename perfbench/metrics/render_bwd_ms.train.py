"""Device ms of the kernels launched inside the program's fr.backward span, on any thread, before its fr.coeff_grad mark (the losses', shading's, K3's, records' and geometry's backward), per step."""

from perfbench import spans


def read(ctx):
    return spans.split_ms(ctx, 'fr.backward', 'fr.coeff_grad', 'before',
                          per='fr.backward')
