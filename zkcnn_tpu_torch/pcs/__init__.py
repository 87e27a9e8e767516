from .hyrax import HyraxPCS

__all__ = ["HyraxPCS"]
