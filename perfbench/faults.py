"""Faults planted under the timed path, to show that the comparison
fails them (tests/test_perfbench_faults.py, and control.py on the chip).
Each takes a cell after its set-up and before its warm-up.

  unchanged   a training step that leaves the model and Adam as they were
  half_batch  a training step on the first half of the batch alone, its
              mean taken over that half
  altered     an answer changed where it is produced: one face's image
              (inference and render), the loss a step returns (training)
"""

from __future__ import annotations

def unchanged(kind):
    real = kind.train_step

    def step(state, images, lmk):
        opt_step = state.optimizer.step
        state.optimizer.step = lambda *a, **k: None
        try:
            return real(state, images, lmk)
        finally:
            state.optimizer.step = opt_step
    kind.train_step = step


def half_batch(kind):
    real = kind.train_step

    def step(state, images, lmk):
        half = images.shape[0] // 2
        return real(state, images[:half], lmk[:half])
    kind.train_step = step


def altered(kind):
    if hasattr(kind, "train_step"):
        real = kind.train_step

        def step(state, images, lmk):
            parts = real(state, images, lmk)
            return dict(parts, total=parts["total"] * 1.1)
        kind.train_step = step
        return
    if getattr(kind, "pipe", None) is not None:
        real_rec = kind.pipe.reconstruct

        def reconstruct(images, *a, **k):
            cv, coeffs, out = real_rec(images, *a, **k)
            return cv, coeffs, _bump(out)
        kind.pipe.reconstruct = reconstruct
        return
    import facerecon_tpu_torch.ops.render as render_mod
    real_render = render_mod.render_coeffs

    def render_coeffs(*a, **k):
        return _bump(real_render(*a, **k))
    render_mod.render_coeffs = render_coeffs


def _bump(out):
    image = out.image.clone()
    image[0] += 0.5
    return out._replace(image=image)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
