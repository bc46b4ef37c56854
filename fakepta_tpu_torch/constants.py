"""Physical and astronomical constants (MKS) used throughout fakepta_tpu_torch.

A copy of ``fakepta_tpu/constants.py`` with the same values (the port imports
nothing of the JAX package). The reference vendors an ENTERPRISE constants module it
never imports (its ``fakepta/constants.py:1-52`` is dead code; the live modules import
``enterprise.constants`` instead). Here the constants module is the single in-package
source of truth and every other module uses it.

Values are CODATA / IAU standard; ``GMsun`` is the measured heliocentric gravitational
constant (more precise than G*Msun separately).
"""

import math

# mathematical
pi = math.pi
e = math.e
log10e = math.log10(math.e)
ln10 = math.log(10.0)

# fundamental (CODATA 2018)
c = 299792458.0                  # speed of light [m/s]
G = 6.67430e-11                  # gravitational constant [m^3 kg^-1 s^-2]
h = 6.62607015e-34               # Planck constant [J s]

# times [s] / frequencies [Hz]
yr = 365.25 * 24 * 3600.0        # Julian year [s]
day = 86400.0                    # day [s]
fyr = 1.0 / yr                   # 1/yr reference frequency [Hz]

# distances [m]
AU = 149597870700.0              # astronomical unit (IAU 2012 exact)
ly = c * yr                      # light year
pc = AU / math.tan(pi / (180 * 3600))  # parsec = 1 AU / 1 arcsec
kpc = pc * 1.0e3
Mpc = pc * 1.0e6
Gpc = pc * 1.0e9

# solar mass and natural-unit equivalents
GMsun = 1.327124400e20           # heliocentric gravitational constant [m^3/s^2]
Msun = GMsun / G                 # solar mass [kg]
Rsun = GMsun / c**2              # solar mass in meters
Tsun = GMsun / c**3              # solar mass in seconds

# cgs energy
erg = 1.0e-7                     # erg [J]

# dispersion-measure constant for DM design-matrix columns [s MHz^2 pc^-1 cm^3]
DM_K = 2.41e-16

# obliquity of the ecliptic [rad] (used by the ephemeris rotations)
OBLIQUITY = 23.43928 * pi / 180.0
