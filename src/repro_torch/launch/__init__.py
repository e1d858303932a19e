"""Port of ``repro.launch``: batched serving (``serve``)."""
