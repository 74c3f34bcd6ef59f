"""Boosting drivers (ref: src/boosting/: GBDT, DART, RF; factory
boosting.cpp:34)."""

from .gbdt import GBDT


def create_boosting(boosting_type: str):
    """ref: src/boosting/boosting.cpp:34 Boosting::CreateBoosting."""
    from ..utils import log
    if boosting_type == "gbdt":
        return GBDT()
    if boosting_type == "dart":
        from .dart import DART
        return DART()
    if boosting_type == "rf":
        from .rf import RF
        return RF()
    log.fatal(f"Unknown boosting type: {boosting_type}")


__all__ = ["GBDT", "create_boosting"]
