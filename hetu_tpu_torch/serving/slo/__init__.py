from .classes import CLASS_RANK, SLO_CLASSES, class_rank

__all__ = ["SLO_CLASSES", "CLASS_RANK", "class_rank"]
