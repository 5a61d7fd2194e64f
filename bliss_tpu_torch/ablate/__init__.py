"""Measurement kernels for the sample-statistics kernel: the port's
counterparts of the TPU harnesses under ``scripts/``.

- ``fused``: the stats kernel with stages switched off (kernel A1) and the
  script's read-and-reduce bodies (``scripts/ablate_fused.py``);
- ``probe``: the read-and-reduce probe kernel A2 they and the next two use;
- ``dma``: launch and copy probes (``scripts/ablate_dma.py``);
- ``packread``: int16 against packed int32 reads
  (``scripts/ablate_packread.py``);
- ``matred``: block reductions as fp64 tensor-core products, with the
  shipped or a narrower Chebyshev fit (kernel A3,
  ``scripts/proto_matred.py``).

``breakdown`` lists every variant and times it on the card, as
``python -m bliss_tpu_torch.ablate`` prints it. None
of this runs on the analysis path.
"""
