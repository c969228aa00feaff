from .base import AbstractType, YEvent
from .yarray import YArray, YArrayEvent
from .ymap import YMap, YMapEvent
from .ytext import YText, YTextEvent
from .yxml import YXmlElement, YXmlEvent, YXmlFragment, YXmlHook, YXmlText

__all__ = [
    "AbstractType",
    "YEvent",
    "YArray",
    "YArrayEvent",
    "YMap",
    "YMapEvent",
    "YText",
    "YTextEvent",
    "YXmlElement",
    "YXmlEvent",
    "YXmlFragment",
    "YXmlHook",
    "YXmlText",
]
