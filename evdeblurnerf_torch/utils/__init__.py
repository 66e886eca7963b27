"""Ray generation and the weight bridge from the JAX package."""
