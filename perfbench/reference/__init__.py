"""Plain PyTorch references of the benchmark's model families: parameter
layouts and initialisation laws (``params``), the forward pass, loss and
served logits (``lm``) and AdamW (``adamw``).

Written from the published descriptions and the configuration files under
``perfbench/configs``; imports neither ``jax`` nor the program under test,
and takes nothing the program made.
"""
