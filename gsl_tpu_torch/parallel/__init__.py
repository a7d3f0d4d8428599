"""Camera data parallelism x Gaussian-sharded model parallelism over
``torch.distributed`` (port of ``gsl_tpu/parallel/``)."""
from .gaussian_sharded import make_mesh, make_mp_train_step
