"""PyTorch/CUDA port of the ADACUR retrieval system (the ``repro`` package
is the JAX reference it is held against).

The module layout mirrors ``repro``'s so every counterpart is easy to find.
The port imports ``torch`` and never ``jax`` or anything of ``repro``.

Precision: every score contraction stays fp32, as in the reference, so TF32
is switched off for matrix products and cuDNN alike when the package is
imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
