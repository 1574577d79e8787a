"""The plain reference: DSRL, its losses, its input transforms and one SGD
step, in plain PyTorch and float32.  It imports nothing of the program and
takes nothing the program made: the run hands both sides the same seeded
weights and inputs, and the reference works out again everything derived
from them."""
