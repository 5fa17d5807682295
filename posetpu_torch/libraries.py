"""Every native library of the port, in one list.

Each library is declared once, beside the code that calls it, as a
:class:`posetpu_torch.utils.cuda_build.Library`: its source, its toolchain
and its C entry points.  Whatever needs all of them (a build of every
library at once, the SASS report's default sources, the tests that hold
each declaration to its C source) reads :data:`LIBRARIES`.  Importing this
module builds nothing.
"""

from posetpu_torch.aug.cuda_kernels import RASTERIZE
from posetpu_torch.models.bn_relu import BN_RELU
from posetpu_torch.models.conv_bias import CONV_BIAS
from posetpu_torch.native.bindings import POOL
from posetpu_torch.native.islow import IDCT
from posetpu_torch.native.jpeg_gpu import ENTROPY
from posetpu_torch.native.ycc import YCC

LIBRARIES = (RASTERIZE, CONV_BIAS, BN_RELU, IDCT, YCC, ENTROPY, POOL)
