"""Port of ``repro.models``: the paper-scale models and the dense decoder
family of the LM stack (config, layers, cache, transformer, api)."""
