"""See the counterpart package enf_pde_tpu.utils."""
