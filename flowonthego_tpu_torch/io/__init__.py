from .flo import read_flo, write_flo

__all__ = ["read_flo", "write_flo"]
