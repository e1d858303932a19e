"""Port of ``repro.launch``: batched serving (``serve``), LM PO-FL training
(``train``, its step functions ``steps`` and its one-card ``mesh``), the
multi-rank launcher (``distributed``) and the parameter sharding rule
(``sharding``)."""
