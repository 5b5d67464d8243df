"""The plain reference that decides `correct`: float32 PyTorch with TF32
off, independent of the program (it imports neither `lavie_tpu_torch` nor
JAX); `numerics.py` also gives the control, the same reference one
precision lower."""
