"""Command-line tools of the port, each run as
``python -m gsl_tpu_torch.tools.<name>``."""
