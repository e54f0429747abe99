"""Device-side compute ops: smoothing kernels, EOS, grid binning, neighbor
sweeps.  This tier replaces the reference's ``@ti.kernel`` native tier
(SURVEY.md §2.9) with jit-fused XLA and Pallas GPU kernels."""

from tisph.ops.kernels import cubic_kernel, cubic_kernel_grad, cubic_kernel_sigma
from tisph.ops.eos import tait_pressure
