"""Models of the port: layers, encodings, voxel fields, renderer, the RBK
blur kernel, AWP/MAM, the CRFs and the top-level system."""
