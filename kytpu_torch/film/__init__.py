from kytpu_torch.film.film import Film, FilmGrid, gamma_encode, to_srgb_u8  # noqa: F401
from kytpu_torch.film.io import (read_hdr, write_bmp, write_hdr,  # noqa: F401
                                 write_image, write_ppm)
