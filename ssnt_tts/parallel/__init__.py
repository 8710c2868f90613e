from ssnt_tts.parallel import decode, mesh, multihost, train

__all__ = ["decode", "mesh", "multihost", "train"]
