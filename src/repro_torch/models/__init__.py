"""The language models (the port of ``repro.models``): the dense family."""
