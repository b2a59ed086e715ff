"""Plain float32 reference of the benchmark: the model math, the seeded
weights, the optimizer update, kernel bounds and FLOP counts. Imports
neither the program under test nor JAX."""
