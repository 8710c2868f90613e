from ssnt_tts.oracle import numpy_oracle

__all__ = ["numpy_oracle"]
