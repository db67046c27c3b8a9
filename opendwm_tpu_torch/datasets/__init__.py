"""Host-side datasets of the port, JAX-free (the JAX package's import
``opendwm_tpu.config``, which loads JAX): the readers, the common layer,
the prefetch loader and the synthetic datasets."""
