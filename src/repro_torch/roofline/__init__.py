"""The roofline and the dry-run's accounting (the port of ``repro.roofline``).

    hw        the NVIDIA H100 SXM 80GB HBM3's peaks (700 W)
    kernels   each kernel's bound: ``KernelRoofline`` models of K1–K6
    counter   ``OpCounter``: flops, bytes, kernel calls, collectives and the
              peak of live storages of one eager step, on meta or a card
    hlo       the reference's wire-byte model over the collectives counted
    analysis  parameter counts, model flops, the depth probes and their
              extrapolation, the roofline terms, decode's byte bound
    memmodel  the per-device memory of the port's state and activations
    report    the dry-run's tables

Three rules hold throughout.

1. A bound is the function's least work, not the schedule's. A kernel's
   ``hbm_bytes`` and ``flops`` count what the function must do: every
   operand read once, every result written once, and the algorithm's
   operations. What the port's current schedule moves (from the kernels'
   own planners) is ``schedule_bytes``, a diagnostic printed beside the
   bound and never its denominator, so a redesign of a kernel cannot move
   the yardstick it is judged by.
2. Count on the meta device exactly what runs on the card. The dry-run runs
   the port's own eager step functions on the meta device under one
   ``OpCounter``, not ``torch.compile``, which would fuse and count
   something other than what runs. Flops are split by the dtype the product
   runs in: bf16 is charged at the tensor cores' peak, float32 (TF32 off)
   at the CUDA cores'. Bytes are each op's operands and results, an upper
   bound on traffic. A kernel call counts once, by its model, not by its
   plain version's passes.
3. The constants are the card's own (``hw``); no TPU figure stays.
"""
