"""Device meshes of the port: the slots a sharded index lays its rows over."""
