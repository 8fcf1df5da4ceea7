"""dctn-tpu's PyTorch port: the EPS model's serving forward (f32 and int8)
and training step (f32 and quantization-aware), and the legacy ConvSBS
model's training runner, on CUDA.

A second package beside ``dctn_tpu`` (the JAX reference, which it never
imports: it runs where only PyTorch is). Module names mirror the JAX
package so each counterpart is easy to find:

  data/      the numpy dataset loader and feature maps
  utils/     Pos2D grid positions
  ops/       windows, rank-one statistics, the reference-layout EPS operator,
             composition inits, the ConvSBS specs, inits and plain fold
  kernels/   the hand-written CUDA kernels (sources in csrc/), their plain
             PyTorch versions, and the EPS layer's and the ConvSBS string's
             autograd.Functions
  models/    EPSesPlusLinear in the fast (cmt) parameter layout; the legacy
             ConvSBS model
  train/     the fast training step, optimizers, and npz checkpoints shared
             with the JAX package
  cli/       the predict entry point (f32 or --quantize int8) and the legacy
             ConvSBS runner
  bench      the training-throughput benchmark (python -m dctn_tpu_torch.bench,
             --qat int8 for the quantization-aware step, --model-family
             conv_sbs for the legacy ConvSBS step)
  interop    the JAX package's parameters (as numpy) <-> the port's tensors,
             and the reference torch state_dict of the ConvSBS model

Every layout at the public functions is the JAX package's: the transposed
batch-minor ``(C, Q, H, W, B)`` input, ``(O, H', W', B)`` between layers and
the flat pixel index ``(h·W' + w)·B + b``, so intermediates compare
one-to-one with the reference.
"""

__version__ = "0.1.0"
