"""The native front doors (``native/src/``), built from the checkout at first
use and bound with ctypes: :mod:`.build` compiles, :mod:`.lib` binds."""
