"""Several ranks (port of ``repro/parallel``): the ``(data, model)`` mesh
over gloo and its collectives' autograd rules (``mesh``), the serving
slices (``sharding``), a train state's shards (``statesharding``) and the
GPipe schedule (``pipeline``)."""
