from .ptq import dequantize_params, quantize_params  # noqa: F401
