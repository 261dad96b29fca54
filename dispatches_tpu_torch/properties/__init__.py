"""Property packages (port of `dispatches_tpu/properties/`): so far `h2`,
the ideal-vapour H2 / turbine-mixture thermodynamics with the H2
combustion data, and `hturbine`, the hydrogen turbine's chain. The steam
and molten-salt packages come with the NLP case studies (ROADMAP A5).
"""
