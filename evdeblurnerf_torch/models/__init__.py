"""Field models of the port: layers, encodings, voxel fields, renderer."""
