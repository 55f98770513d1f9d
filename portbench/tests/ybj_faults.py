"""Faults planted in the YBJ model for the tests (``Job.prepare`` runs one
before the model is built): each changes what the program computes, so a
run with it must come out not correct."""


def step_unchanged():
    """A step that returns phi unchanged: it does its work, and only the
    clock advances (so the run keeps the pace of a sound one)."""
    from niwqg_tpu_torch.models.ybj import YBJKernel

    orig = YBJKernel.step

    def step(self, s):
        out = orig(self, s)
        return out._replace(phih=s.phih, d=s.d)

    YBJKernel.step = step


def phi_altered():
    """Every step's phi altered where it is produced: one coefficient of
    the new ``phih`` moved by 1% of the spectrum's largest."""
    from niwqg_tpu_torch.models.ybj import YBJKernel

    orig = YBJKernel.step

    def step(self, s):
        out = orig(self, s)
        phih = out.phih.clone()
        phih[1, 1] += 0.01 * phih.abs().max()
        return out._replace(phih=phih)

    YBJKernel.step = step
