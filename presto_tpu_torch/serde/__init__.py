"""SerializedPages: the wire format of the worker exchange."""

from .pages import (PageCodec, deserialize_page, deserialize_to_arrays,
                    serialize_batch, serialize_page)

__all__ = ["serialize_page", "deserialize_page", "PageCodec",
           "serialize_batch", "deserialize_to_arrays"]
