"""utils — timing, VTK, Gmsh, MRST and plotting helpers (host numpy)."""
