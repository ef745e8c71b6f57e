"""Device meshes and logical-axis sharding (port of ``repro.distributed``)."""
