"""Multi-device training and serving on ``torch.distributed`` (port of
``ml_audio_inpainting_tpu/parallel/``).

The JAX package is single-controller: ``jax.jit`` with shardings turns the
one-device step into a partition of it and XLA inserts the collectives, so
its sharded step is the one-device step as a function of the global batch.
``torch.distributed`` runs one process a rank, and the port writes those
collectives itself.  Every module follows four rules:

1. **Every batch reduction of a step is global.**  BatchNorm's per-channel
   ``E[x]`` and ``E[x^2]``, the CNN's sum-reduced L1, the GAN's
   ``sum / count`` normalisers and means (BCE, the VGG terms) and the VGG
   target's batch maximum are reduced over the ``data`` group in f32
   (:mod:`~ml_audio_inpainting_torch.parallel.collectives`).  The reduction
   a loss ends in has an identity backward: every rank holds the same loss,
   and an ``all_reduce`` backward would count each contribution once a rank.
   BatchNorm's moments feed each rank's own activations, so the gradient
   that reaches them is a partial one; their backward sums it over ``data``
   (as ``SyncBatchNorm`` does).
2. **Gradients are summed over the ``data`` group**, once, after the
   backward and before Adam (plain DDP averages, which is wrong by the data
   width for these losses).
3. **Tensor-parallel layers follow Megatron's pair.**  The BiLSTM input
   projection ``w_ih`` is split on its input dimension (JAX ``P("model",
   None)``): each model rank multiplies its slice of the replicated input,
   the partial products are summed over ``model`` in f32 and rounded once,
   and the input's gradient is gathered.  The dense ``projection`` is split
   on its output dimension (JAX ``P(None, "model")`` of an ``(in, out)``
   kernel; ``dim 0`` of torch's ``(out, in)`` weight): the output slices are
   gathered, and the input's partial gradients are summed over ``model``.
   Biases stay replicated.  Adam's moments and the EMA of a sharded
   parameter live with its shard.
4. **The one-device path does not change.**  Outside
   :func:`~ml_audio_inpainting_torch.parallel.collectives.use_mesh`, or on
   an axis of size 1, every hook is the code it replaces.

The layers act on local tensors (not DTensor), so the LSTM kernels still
receive plain contiguous tensors.
"""
