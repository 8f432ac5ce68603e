"""Host-side mesh extraction (numpy copies of ``diffudf_tpu/extract``)."""

from .cap import extract_mesh_cap
from .meshudf import extract_mesh_meshudf
from .postprocess import clean_mesh, smooth_borders
from .sdf_mc import extract_mesh_signed
from .table_mc import marching_cubes_cells
from .tet_mc import marching_tets_cells
from .triangulate import DEFAULT_TRIANGULATOR, TRIANGULATORS, triangulate_cells

__all__ = [
    "marching_tets_cells",
    "marching_cubes_cells",
    "extract_mesh_cap",
    "extract_mesh_meshudf",
    "extract_mesh_signed",
    "clean_mesh",
    "smooth_borders",
    "triangulate_cells",
    "TRIANGULATORS",
    "DEFAULT_TRIANGULATOR",
]
