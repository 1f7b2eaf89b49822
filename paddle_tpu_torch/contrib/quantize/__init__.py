from .quantize_transpiler import (QuantizeTranspiler,  # noqa: F401
                                  export_int8_params, load_int8_params)
