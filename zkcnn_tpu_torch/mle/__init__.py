from .beta import beta_table, beta_table_2pt, phi_table
from .fold import fold, coeffs_quadratic_dots, mle_eval
