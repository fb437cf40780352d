"""The native front doors and the local engine's sliding window
(``native/src/``), built from the checkout at first use and bound with
ctypes: :mod:`.build` compiles, :mod:`.lib` binds."""
