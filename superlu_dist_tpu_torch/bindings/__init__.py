"""The C and Fortran API of the port (slu_tpu.h over an embedded
interpreter, ``capi_impl``), built by ``build`` into the checkout's
``build/`` directory."""
