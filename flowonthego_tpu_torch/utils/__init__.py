from .metrics import average_epe, endpoint_error

__all__ = ["average_epe", "endpoint_error"]
