"""The plain reference: the scene from the configuration file, and a
renderer of any set of rays in plain PyTorch."""
