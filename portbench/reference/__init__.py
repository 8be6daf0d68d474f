"""The plain reference the benchmark holds the port to: the unfolded
UNet3D with the weight-normalised convs of a Hebbian fine-tune, the dice
and entropy losses and the SGD update in plain float32 PyTorch (TF32
off), and the patch queue's draws frozen in NumPy.  It imports nothing of ``hebbax_torch``
or ``hebbax`` and takes nothing the program made: it starts from the
benchmark's weights and inputs and works the batches out again."""
