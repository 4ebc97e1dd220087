from egovlp_tpu_torch.kernels.divided_attention import divided_attention  # noqa: F401
