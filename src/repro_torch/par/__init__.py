"""Device meshes of the port (the slots a sharded index lays its rows over)
and the path-rule sharding specs over them."""
