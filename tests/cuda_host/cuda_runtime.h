// Stands in for the CUDA runtime header when a kernel source is built on the host (cuda_emu.h).
#pragma once
