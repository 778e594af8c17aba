"""Plain references that decide ``correct``: PyTorch and NumPy only.

Nothing here imports the program (``sfd2_torch``), JAX or the JAX
package; every input comes from the benchmark's own scene, images and
weights, and the program's outputs are read only to judge them.
"""
