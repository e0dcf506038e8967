from .run import run

__all__ = ["run"]
