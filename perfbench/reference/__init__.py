"""The plain reference: the model's loss and gradients, Gaussian-k with
error feedback, the mean over the workers and SGD with momentum, in
plain PyTorch.  It imports nothing of the program (``repro_torch``), of
the JAX package (``repro``) or of JAX."""
