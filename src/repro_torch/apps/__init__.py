"""The paper's §4 applications on torch (counterparts of ``repro.apps``):

* :mod:`repro_torch.apps.mcmc`       — §4.1 ideal-point MCMC (task farm,
                                       Table 1)
* :mod:`repro_torch.apps.dmc`        — §4.2 diffusion Monte Carlo with
                                       dynamic load balancing (Table 2)
* :mod:`repro_torch.apps.boussinesq` — §4.3 Boussinesq waves via additive
                                       Schwarz (Table 3)
"""
