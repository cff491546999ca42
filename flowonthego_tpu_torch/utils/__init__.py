from .metrics import angular_error, average_epe, endpoint_error

__all__ = ["average_epe", "endpoint_error", "angular_error"]
