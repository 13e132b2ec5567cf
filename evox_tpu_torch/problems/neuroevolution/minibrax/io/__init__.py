from . import html, image

__all__ = ["html", "image"]
