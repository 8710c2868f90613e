from ssnt_tts.utils import config

__all__ = ["config"]
