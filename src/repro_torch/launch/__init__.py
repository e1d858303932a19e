"""Port of ``repro.launch``: batched serving (``serve``), the multi-rank
launcher (``distributed``) and the parameter sharding rule (``sharding``)."""
