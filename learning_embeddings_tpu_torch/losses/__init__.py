from .classification import make_multi_level_ce

__all__ = ["make_multi_level_ce"]
