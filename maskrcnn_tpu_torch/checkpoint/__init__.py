"""Weight bridge from the JAX package's parameter trees."""
