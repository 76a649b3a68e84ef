"""Distribution (the port of ``repro.distributed``): the sharding rules
and their DTensor placements (``sharding``), and gradient compression
with error feedback and the compressed all-reduce (``compression``)."""
