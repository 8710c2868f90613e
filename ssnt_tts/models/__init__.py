from ssnt_tts.models.ssnt import SSNTModel

__all__ = ["SSNTModel"]
