"""PyTorch/CUDA port of the ADACUR retrieval system (the ``repro`` package
is the JAX reference it is held against).

The module layout mirrors ``repro``'s so every counterpart is easy to find.
The port imports ``torch`` and never ``jax`` or anything of ``repro``.

Precision: every score contraction stays fp32, as in the reference, so TF32
is switched off for matrix products and cuDNN alike when the package is
imported.  A bf16 product accumulates in fp32, as the reference's bf16 dots
do, so cuBLAS's reduced-precision reductions (split-K partial sums rounded
to bf16, which it takes for skinny products such as a decode step's) are
switched off too: they put a 3.3e-3 relative error on qwen3-8b's first
decode layer on an H100, where fp32 partial sums leave none beyond the
output's own rounding.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
