"""The JAX package's examples on the port, each runnable as
``python -m bp_osd_tpu_torch.examples.<name>``; outputs go to the path given
on the command line (default: a ``*_torch.json`` name in the working
directory)."""
