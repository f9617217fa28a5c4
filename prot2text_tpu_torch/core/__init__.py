from .device import resolve_device
from .dtypes import str2bool, str2dtype

__all__ = ["resolve_device", "str2bool", "str2dtype"]
