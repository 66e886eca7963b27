"""Ray generation, SE(3) maps, the EGM loss and the weight bridge from the
JAX package."""
