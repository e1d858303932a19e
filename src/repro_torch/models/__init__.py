"""Port of ``repro.models``: the paper-scale models and every family of the
LM stack (config, layers, cache, transformer, encdec, api)."""
