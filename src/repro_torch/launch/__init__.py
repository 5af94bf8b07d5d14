"""Launch: device meshes and step builders (port of the reference's
``launch/``)."""
