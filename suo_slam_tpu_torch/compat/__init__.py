"""Drop-in API shims for the reference's native dependencies, on the port's
solvers.

Port of `suo_slam_tpu/compat`: `compat.lambdatwist` and `compat.g2o` expose
the Python surfaces the reference engine consumes (`lambdatwist.pnp`; the
g2o SparseOptimizer / SE3Quat / VertexSE3Expmap / Edge* classes), backed by
`solvers/pnp.py` (K15 on the card) and `solvers/ba.lm_run` (K4 + K7 on the
card) instead of the reference's C++ builds. Code written against the
reference's `import g2o` / `import lambdatwist` runs unmodified on the card:

    import sys
    import suo_slam_tpu_torch.compat as compat
    sys.modules["g2o"] = compat.g2o
    sys.modules["lambdatwist"] = compat.lambdatwist

Both default to the card (`device="cuda"`, raising without one) and take
`device="cpu"` for the plain versions.
"""

from . import g2o, lambdatwist  # noqa: F401
