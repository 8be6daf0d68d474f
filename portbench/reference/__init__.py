"""The plain reference the benchmark holds the port to: each
configuration's network by its ``arch`` (``arch_<arch>.py``, the
unfolded UNet3D with the weight-normalised convs of a Hebbian layer),
the dice and entropy losses, the swta deltas written from the rule, and
the SGD and Adam updates in plain float32 PyTorch (TF32 off), and the
patch queue's draws frozen in NumPy.  It imports nothing of
``hebbax_torch`` or ``hebbax`` and takes nothing the program made: it
starts from the benchmark's weights and inputs and works the batches out
again."""
