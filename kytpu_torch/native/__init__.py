"""Optional native (C++) host-side components (kytpu/native).

`film_io` is a ctypes binding to a small C++ encoder for the BMP and HDR
image writers (the reference's only native host-side runtime besides the
render loop, ky.cpp:1646-1782). Build it with `python -m
kytpu_torch.native.build`, which puts the library in kytpu_torch/_build/;
film/io.py then writes through it, and through numpy while it is absent,
with the same bytes.
"""
