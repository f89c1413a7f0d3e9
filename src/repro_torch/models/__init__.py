"""The language models (the port of ``repro.models``): the dense, moe, vlm,
ssm, hybrid and audio families."""
