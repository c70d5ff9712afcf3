from .pdb import (parse_pdb, read_cif_atoms, read_pdb_atoms,
                  write_backbone_pdb)
from .featurize import (featurize_inference, get_score, get_seq_rec,
                        make_pair_bias_ctx, renumber_duplicate_resnums)
