"""The plain reference: both proof systems in Python ints, importing
nothing of the program, of JAX or of torch."""
